"""Ring and Ulysses attention in the port (``dynamo_tpu_torch.parallel.
ring_attention`` / ``ulysses``) held against the JAX package's on an
``"sp"`` mesh of the same size over the suite's CPU devices, the port's
ranks being the processes of a gloo world (``torch_tp_world.py``), with
the shapes of ``tests/test_parallel_attention.py`` (B 2, T 64, hd 16):

- ring, causal and not, H 8 / KV 4, and a GQA case (H 8 / KV 2), in
  worlds of 2 and 4, within 2e-5 of JAX's ``make_ring_attention`` and of
  the plain ``_full_attention``;
- Ulysses, causal and not, H 16 / KV 8, within 2e-5 of JAX's
  ``make_ulysses_attention``; heads the ranks do not divide are refused;
- a query row that no key reaches (``l`` stays 0) comes out as zeros in
  both packages;
- one ring makes n - 1 hops of K and n - 1 of V, each carrying the
  rank's chunk, and nothing else;
- the collectives themselves on (2, 2) and (4, 1) meshes: mesh-major
  coordinates, the tp rows and dp columns, an exact all_gather (``-0.0``
  keeps its sign), the ring's ppermute, all_to_all, and sums per group.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dynamo_tpu.parallel import make_ring_attention, make_ulysses_attention
from dynamo_tpu.parallel.ulysses import _full_attention as jax_full

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_world as tw  # noqa: E402

TOL = 2e-5


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


def _inputs(B=2, T=64, H=8, KV=4, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd)))


def _jax(make, n, q, k, v, causal=True):
    mesh = Mesh(np.asarray(jax.devices("cpu")[:n]), ("sp",))
    spec = NamedSharding(mesh, P(None, "sp", None, None))
    args = (jax.device_put(jnp.asarray(x), spec) for x in (q, k, v))
    return np.asarray(make(mesh, causal=causal)(*args))


def _check(got, want):
    for out, _ in got:
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("world", [2, 4], indirect=True, ids=["n2", "n4"])
def test_ring_matches_jax(world, causal):
    q, k, v = _inputs()
    want = _jax(make_ring_attention, world.n, q, k, v, causal)
    _check(world.run(tw.attention_case, "ring", q, k, v, causal), want)
    full = np.asarray(jax_full(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal))
    np.testing.assert_allclose(want, full, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world", [2, 4], indirect=True, ids=["n2", "n4"])
def test_ring_gqa_matches_jax(world):
    """H 8 over KV 2: a query head reads its own group's K/V only."""
    q, k, v = _inputs(H=8, KV=2, seed=3)
    want = _jax(make_ring_attention, world.n, q, k, v)
    _check(world.run(tw.attention_case, "ring", q, k, v), want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("world", [2, 4], indirect=True, ids=["n2", "n4"])
def test_ulysses_matches_jax(world, causal):
    q, k, v = _inputs(H=16, KV=8)
    want = _jax(make_ulysses_attention, world.n, q, k, v, causal)
    _check(world.run(tw.attention_case, "ulysses", q, k, v, causal), want)


def test_ulysses_refuses_heads_the_ranks_do_not_divide(world4):
    q, k, v = _inputs(H=6, KV=2)
    for out, msg in world4.run(tw.attention_case, "ulysses", q, k, v):
        assert out is None and "must divide sp=4" in msg
    with pytest.raises(ValueError, match="must divide sp=4"):
        _jax(make_ulysses_attention, 4, q, k, v)


def test_a_row_no_key_reaches_comes_out_zero(world2):
    """Query row 5 of batch 0 is -inf against all-positive keys: every
    score is -inf, ``l`` stays 0, and the guarded divide gives zeros, as
    in JAX; the other rows are untouched."""
    q, k, v = _inputs(seed=7)
    k = np.abs(k) + 0.1
    q[0, 5] = -np.inf
    want = _jax(make_ring_attention, 2, q, k, v)
    assert (want[0, 5] == 0).all() and np.isfinite(want).all()
    got = world2.run(tw.attention_case, "ring", q, k, v)
    for out, _ in got:
        assert (out[0, 5] == 0).all()
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world", [2, 4], indirect=True, ids=["n2", "n4"])
def test_one_ring_makes_n_minus_one_hops_per_k_and_v(world):
    q, k, v = _inputs()
    n = world.n
    C = q.shape[1] // n
    got = world.run(tw.ring_body, q, k, v)
    want = _jax(make_ring_attention, n, q, k, v)
    chunk_bytes = k[:, :C].nbytes
    for r, (out, st) in enumerate(got):
        np.testing.assert_allclose(out, want[:, r * C:(r + 1) * C],
                                   rtol=TOL, atol=TOL)
        assert st["ppermute_calls"] == 2 * (n - 1)
        assert st["ppermute_bytes"] == 2 * (n - 1) * chunk_bytes
        assert st["staged_bytes"] == 0          # CPU tensors: no staging
        assert sum(st[f"{op}_calls"] for op in (
            "all_reduce", "broadcast", "all_gather", "all_to_all")) == 0


@pytest.mark.parametrize("world,shape", [(4, (2, 2)), (4, (4, 1)),
                                         (2, (1, 2))],
                         indirect=["world"], ids=["2x2", "4x1", "1x2"])
def test_collectives_over_mesh_groups(world, shape):
    dp, tp = shape
    got = world.run(tw.collectives, dp, tp)
    n = dp * tp
    for r, g in enumerate(got):
        d, t = r // tp, r % tp
        assert g["coords"] == {"dp": d, "tp": t}
        assert g["tp_ranks"] == [d * tp + j for j in range(tp)]
        assert g["dp_ranks"] == [e * tp + t for e in range(dp)]
        assert g["tp_rank"] == t
        col = g["dp_ranks"]
        gathered = g["gather_dp"].reshape(len(col), 3)
        for i, m in enumerate(col):
            np.testing.assert_array_equal(
                gathered[i], np.array([-0.0, m, 0.5 + m], np.float32))
        # the sign of -0.0 survives: an exact gather, not a padded sum
        assert np.signbit(g["gather_world"][::3]).all()
        prev = col[(col.index(r) - 1) % len(col)]
        np.testing.assert_array_equal(
            g["ppermute_dp"], np.array([-0.0, prev, 0.5 + prev], np.float32))
        np.testing.assert_array_equal(
            g["a2a_world"], np.array([r + 10 * j for j in range(n)],
                                     np.float32))
        assert g["sum_tp"] == sum(g["tp_ranks"])
        assert g["sum_dp"] == sum(col)
        assert g["bcast_world"] == 0.0
