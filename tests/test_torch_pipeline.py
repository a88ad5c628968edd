"""GPipe pipeline parallelism in the port, held against the JAX package:
the port's ``make_pipeline`` over a gloo world of S ranks on the CPU
(``torch_tp_world.py``, one stage per rank) against the JAX
``make_pipeline`` over S virtual CPU devices, on ``tests/test_pipeline.py``'s
residual MLP stage, from the same numpy inputs.

- S = 2 and 4 stages, M = 6 microbatches and M = 1 (the full bubble):
  outputs within 1e-5 of JAX's (both f32), and equal on every rank (the
  last stage's output is broadcast bit for bit);
- only the hops that carry data are posted: each microbatch crosses each
  of the S - 1 stage boundaries once, so a stage sends M activations
  (the last none) and posts M hops (a middle stage M + 1, a receive
  sharing a tick with a send);
- ``stage_slice`` cuts a leading axis into the stages' parts and refuses
  one the stages do not divide.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dynamo_tpu.parallel.pipeline import make_pipeline, stage_shardings
from dynamo_tpu_torch.parallel.pipeline import stage_slice

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_world as tw  # noqa: E402

ATOL = 1e-5
D, F, MB = 16, 32, 2


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


def _stage_fn(p, x):
    """``tests/test_pipeline.py``'s residual MLP block."""
    return x + jnp.tanh(x @ p["w1"]) @ p["w2"]


def _inputs(S, M, seed):
    rng = np.random.default_rng(seed)
    params = {
        "w1": (rng.standard_normal((S, D, F)) / np.sqrt(D)).astype(
            np.float32),
        "w2": (rng.standard_normal((S, F, D)) / np.sqrt(F)).astype(
            np.float32),
    }
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    return params, x


def _jax(S, params, x):
    mesh = Mesh(np.asarray(jax.devices("cpu")[:S]), ("pp",))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    sharded = jax.device_put(jp, stage_shardings(mesh, jp))
    return np.asarray(make_pipeline(mesh, _stage_fn)(sharded,
                                                     jnp.asarray(x)))


@pytest.mark.parametrize("M", [6, 1], ids=["M6", "M1"])
@pytest.mark.parametrize("world", [2, 4], indirect=True, ids=["S2", "S4"])
def test_make_pipeline_matches_jax(world, M, cpu_devices):
    S = world.n
    params, x = _inputs(S, M, seed=10 * S + M)
    want = _jax(S, params, x)
    got = world.run(tw.pipeline_case, params, x)
    for stage, (out, hops, sent) in enumerate(got):
        np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(out, got[0][0])
        assert hops == M + (0 < stage < S - 1)
        assert sent == (M * x[0].nbytes if stage < S - 1 else 0)


def test_stage_slice_cuts_the_leading_axis():
    tree = {"a": torch.arange(8).reshape(4, 2),
            "q": {"q": torch.arange(4), "s": torch.ones(4, 3)}}
    part = stage_slice(tree, 1, 2)
    assert part["a"].tolist() == [[4, 5], [6, 7]]
    assert part["q"]["q"].tolist() == [2, 3]
    assert part["q"]["s"].shape == (2, 3)
    assert stage_slice(tree, 3, 4)["a"].tolist() == [[6, 7]]
    with pytest.raises(ValueError, match="does not split over 3 stages"):
        stage_slice(tree, 0, 3)
